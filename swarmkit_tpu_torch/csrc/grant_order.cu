// K19 grant_order: the free slots of a pool's probe range in circular probe
// order from its cursor.
//
// Replaces: swarmkit_tpu/ops/alloc.py `_grant_kernel` (:45, jit at :51),
// reached through `grant_order` (:65):
//   span  = hi - lo + 1;  start = cursor if lo <= cursor <= hi else lo
//   key   = (pos - start) % span  for pos in [lo, hi]
//   order = pos[argsort(where(free, key, span))]   (stable)
//   out   = order[:sum(free)]                       int32[n_free]
// The key is a bijection of [lo, hi] onto [0, span), so no two free slots
// tie and the sort is a rotated stream compaction: the free positions of
// [start, hi] in order, then those of [lo, start - 1].
//
// Integer bounds: a pool holds size <= 2^32 addresses (IPv4); the host
// refuses size >= 2^31, so span <= size - 1 < 2^31 and every position
// lo + j <= hi < 2^31 fits int32, as the reference's int32 `pos` does. The
// rotated index i stays in [0, span) and the unrotated slot j as well (the
// wrap is taken before the add, see `rotate`), and a count of free slots is
// at most span.
//
// Bound on this card: memory. It must read span bytes and write 4 * n_free
// + 4 (a /16 pool: 65,533 bytes in, up to 256 KB out); the mask is read
// twice here (count, write).
//
// Design: the pattern of K15 (csrc/diff_compact.cu) over the rotated index.
// Tiles of 4096 slots (4 sub-tiles of 1024, neighbouring threads on
// neighbouring slots, so reads stay coalesced but at the one wrap): (1) each
// tile counts its free slots; (2) one block turns the tile counts into
// exclusive offsets, in place, and writes the total as n_free; (3) each tile
// scans its free flags again, block-wide and in order, and writes base + j
// at its offset.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace skt {

constexpr int GO_THREADS = 1024;
constexpr int GO_SUB = 4;
constexpr int GO_TILE = GO_THREADS * GO_SUB;

// The slot j of rotated index i, for i and s0 in [0, span): (s0 + i) % span.
// s0 + i may pass 2^31 - 1 when span > 2^30, so compare before adding.
__device__ __forceinline__ int32_t rotate(int32_t i, int32_t s0,
                                          int32_t span) {
  const int32_t tail = span - s0;            // in [1, span]
  return i < tail ? s0 + i : i - tail;
}

// The free flag of rotated index i (0 past the span). The tile index is
// taken in 64 bits: n_tiles * GO_TILE may pass 2^31 by up to GO_TILE - 1.
__device__ __forceinline__ int32_t free_at(const uint8_t* __restrict__ taken,
                                           int64_t i, int32_t s0,
                                           int32_t span, int32_t* j) {
  if (i >= span) return 0;
  *j = rotate((int32_t)i, s0, span);
  return taken[*j] ? 0 : 1;
}

__global__ void go_count_kernel(const uint8_t* __restrict__ taken,
                                int32_t* tile_free, int32_t s0,
                                int32_t span) {
  __shared__ int32_t red[32];
  const int64_t base = (int64_t)blockIdx.x * GO_TILE;
  int32_t c = 0;                             // <= GO_TILE
  for (int k = 0; k < GO_SUB; ++k) {
    int32_t j;
    c += free_at(taken, base + k * GO_THREADS + threadIdx.x, s0, span, &j);
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) tile_free[blockIdx.x] = c;
}

// One block: tile_free[t] becomes the exclusive offset of tile t (<= span),
// and *n_free the total.
__global__ void go_scan_kernel(int32_t* tile_free, int n_tiles,
                               int32_t* n_free) {
  __shared__ int32_t sh[32];
  int32_t carry = 0;                         // <= span
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int32_t v = t < n_tiles ? tile_free[t] : 0;
    int32_t chunk;
    const int32_t ex = block_excl_scan(v, sh, &chunk);
    if (t < n_tiles) tile_free[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) *n_free = carry;
}

__global__ void go_write_kernel(const uint8_t* __restrict__ taken,
                                const int32_t* tile_off, int32_t* out,
                                int32_t s0, int32_t span, int32_t pos_base) {
  __shared__ int32_t sh[32];
  const int64_t base = (int64_t)blockIdx.x * GO_TILE;
  int32_t off = tile_off[blockIdx.x];        // + the tile's count <= span
  for (int k = 0; k < GO_SUB; ++k) {
    int32_t j = 0;
    const int32_t f =
        free_at(taken, base + k * GO_THREADS + threadIdx.x, s0, span, &j);
    int32_t chunk;
    const int32_t pos = off + block_excl_scan(f, sh, &chunk);
    if (f) out[pos] = pos_base + j;          // <= hi < 2^31
    off += chunk;
  }
}

}  // namespace skt

extern "C" int skt_grant_order_tile() { return skt::GO_TILE; }

// taken: uint8[span], the pool's mask from lo to hi (1 = taken);
// out: int32[span], its first n_free entries written; n_free: int32[1];
// scratch: int32[n_tiles], n_tiles = ceil(span / GO_TILE); s0 = start - lo
// in [0, span); pos_base = lo.
extern "C" int skt_grant_order(const void* taken, void* out, void* n_free,
                               void* scratch, int span, int s0, int pos_base,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)taken;
  int32_t* tiles = (int32_t*)scratch;
  const int n_tiles = (int)(((int64_t)span + skt::GO_TILE - 1) / skt::GO_TILE);
  skt::go_count_kernel<<<n_tiles, skt::GO_THREADS, 0, st>>>(m, tiles, s0,
                                                            span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skt::go_scan_kernel<<<1, skt::GO_THREADS, 0, st>>>(tiles, n_tiles,
                                                     (int32_t*)n_free);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skt::go_write_kernel<<<n_tiles, skt::GO_THREADS, 0, st>>>(
      m, tiles, (int32_t*)out, s0, span, pos_base);
  return (int)cudaGetLastError();
}
