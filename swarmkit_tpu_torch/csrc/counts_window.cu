// K6 counts_window: the real [G, N] window of a resident tick's padded
// counts, as one contiguous array, downcast to int16 when the tick is
// compact.
//
// Replaces: swarmkit_tpu/ops/resident.py `_slice_counts` (:162) together
// with the compact downcast of `_resident_tick_impl` (:102-103):
//   out[g, n] = (int16 or int32) counts[g, n] for g < G, n < N
// where counts is int32[Gp, Np]. The host takes the int16 form only when
// max(n_tasks) < 2^15, so no count is cut.
//
// Bound on this card: memory in principle, 4 bytes read and 2 (or 4)
// written per window cell: 1.2 MB and 0.00036 ms at the grid tick's 20 x
// 10,000 int16 of 20 x 16,384. In practice launch latency bounds it: the
// counts were just written by the fill, so at that size the reads hit the
// 50 MB L2, and a launch costs a few microseconds whatever it moves. TMA and
// wgmma are not tools for a copy this small; what helps is few, wide
// memory operations and a grid no larger than the card runs at once.
//
// Design: a 1-D grid-stride loop over the window's cells, at most
// kBlocksPerSm blocks of 256 threads on each SM.
//   * vector path: a thread moves 4 neighbouring cells of a row, one 16-byte
//     load (int4) and one 8-byte (4 int16) or 16-byte (4 int32) store. The
//     host takes it only when Np % 4 == 0, N % 4 == 0 and both base
//     pointers are 16-byte aligned, so every row of both arrays starts
//     aligned and no row has a tail;
//   * scalar path: a thread moves one cell, for every other window.
// A thread finds its first cell's row and column with one 32-bit division
// of its thread index, then steps a grid's worth of cells at a time (dg
// rows and dc columns, one carry) with 64-bit flat indices: no 64-bit
// division, which the card emulates in software.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ void store(int32_t* out, int32_t v) { *out = v; }

__device__ __forceinline__ void store(int16_t* out, int32_t v) {
  *out = (int16_t)v;
}

__device__ __forceinline__ void store(int4* out, int4 v) { *out = v; }

__device__ __forceinline__ void store(short4* out, int4 v) {
  *out = make_short4((short)v.x, (short)v.y, (short)v.z, (short)v.w);
}

// out[g, c] = counts[g, c] for g < G, c < N, rows Np apart in counts; In
// is the unit a thread moves (int32_t, or int4: 4 cells, N and Np then
// counted in vectors). The grid never holds 2^32 threads (blocks_for).
template <typename In, typename Out>
__global__ void counts_window_kernel(const In* __restrict__ counts,
                                     Out* __restrict__ out, int G, int N,
                                     int Np) {
  const unsigned n = (unsigned)N;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned dg = step / n, dc = step - dg * n;
  unsigned c = t % n;
  for (int64_t g = t / n; g < G;) {
    store(out + g * N + c, counts[g * Np + c]);
    c += dc;
    g += dg;
    if (c >= n) {
      c -= n;
      ++g;
    }
  }
}

unsigned blocks_for(long long cells) {
  static int sms = 0;   // the card's SM count, read once
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms = n;
  }
  const long long need = (cells + kThreads - 1) / kThreads;
  const long long most = (long long)kBlocksPerSm * sms;
  return (unsigned)(need < most ? need : most);
}

template <typename In, typename Out>
int launch(const void* counts, void* out, int G, int N, int Np,
           void* stream) {
  const unsigned grid = blocks_for((long long)G * N);
  if (grid == 0) return (int)cudaSuccess;
  counts_window_kernel<In, Out><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const In*)counts, (Out*)out, G, N, Np);
  return (int)cudaGetLastError();
}

}  // namespace skt

// One cell a thread, any window.
extern "C" int skt_counts_window(const void* counts, void* out, int G, int N,
                                 int Np, int compact, void* stream) {
  return compact
             ? skt::launch<int32_t, int16_t>(counts, out, G, N, Np, stream)
             : skt::launch<int32_t, int32_t>(counts, out, G, N, Np, stream);
}

// Four cells a thread; only for N % 4 == 0, Np % 4 == 0 and both pointers
// 16-byte aligned (the host checks).
extern "C" int skt_counts_window_vec4(const void* counts, void* out, int G,
                                      int N, int Np, int compact,
                                      void* stream) {
  return compact
             ? skt::launch<int4, short4>(counts, out, G, N / 4, Np / 4, stream)
             : skt::launch<int4, int4>(counts, out, G, N / 4, Np / 4, stream);
}
