// K14 global_diff: the global orchestrator's desired-vs-actual set diff,
// with the optional slot-set prologue of the device-resident update.
//
// Replaces: swarmkit_tpu/ops/reconcile.py `global_diff` (:34) and `_diff`
// (:185), and the slot set of `global_diff_update` (:46):
//   tn[upd_rows[u], upd_cols[u]] = upd_vals[u]             (update form)
//   has[s, n]      = any t: tn[s, t] >= 0 and min(tn[s, t], N - 1) == n
//   create[s, n]   = eligible[s, n] and not has[s, n]
//   shutdown[s, n] = not eligible[s, n] and has[s, n]
// eligible bool[S, N] and the outputs are one byte a cell; tn is int32[S, T]
// (the -1-padded node ids of each service's tasks; ids >= N clip to N - 1,
// as the reference's scatter does).
//
// Bound on this card: memory. It must read S * N + 4 * S * T bytes and
// write 2 * S * N (at 20 x 50,500 nodes: about 3 MB, 1 us at 3.35 TB/s);
// one compare and two logic ops a cell.
//
// Design: three simple passes on the stream. (1) memset the shutdown
// output to 0: it serves as the `has` plane; (2) one thread per (s, t)
// writes has[s * N + min(tn, N - 1)] = 1 where tn >= 0 (threads that hit
// the same cell write the same value); (3) one elementwise pass reads
// eligible and has and writes create and shutdown, 16 bytes a thread when
// the three planes are 16-byte aligned. The update form runs U threads
// first that set the slots in the (already copied) table. Offsets are 64
// bits: the reference's scatter is 2-D here and does not wrap at
// S * N >= 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void slot_set_kernel(int32_t* tn, const int32_t* rows,
                                const int32_t* cols, const int32_t* vals,
                                int T, int U) {
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < U;
       u += gridDim.x * blockDim.x)
    tn[(int64_t)rows[u] * T + cols[u]] = vals[u];
}

__global__ void has_scatter_kernel(const int32_t* __restrict__ tn,
                                   uint8_t* __restrict__ has, int S, int N,
                                   int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int32_t v = tn[(int64_t)s * T + t];
    if (v >= 0) has[(int64_t)s * N + (v < N ? v : N - 1)] = 1;
  }
}

// has and shutdown are the same plane: each thread reads its cells of it
// before it writes them.
__global__ void diff_vec_kernel(const uint4* __restrict__ elig,
                                uint4* create, uint4* shutdown,
                                int64_t words) {
  const uint32_t one = 0x01010101u;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (int64_t)gridDim.x * blockDim.x) {
    const uint4 e = elig[i];
    const uint4 h = shutdown[i];
    create[i] = make_uint4(e.x & ~h.x & one, e.y & ~h.y & one,
                           e.z & ~h.z & one, e.w & ~h.w & one);
    shutdown[i] = make_uint4(~e.x & h.x & one, ~e.y & h.y & one,
                             ~e.z & h.z & one, ~e.w & h.w & one);
  }
}

__global__ void diff_byte_kernel(const uint8_t* __restrict__ elig,
                                 uint8_t* create, uint8_t* shutdown,
                                 int64_t begin, int64_t cells) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < cells; i += (int64_t)gridDim.x * blockDim.x) {
    const uint8_t e = elig[i], h = shutdown[i];
    create[i] = e & !h;
    shutdown[i] = !e & h;
  }
}

inline unsigned grid_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return (unsigned)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace skt

// rows/cols/vals: int32[U] update triples (null when U == 0); tn is the
// task table the diff reads, updated in place by the prologue.
extern "C" int skt_global_diff(const void* eligible, void* tn,
                               const void* rows, const void* cols,
                               const void* vals, void* create,
                               void* shutdown, int S, int N, int T, int U,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int64_t cells = (int64_t)S * N;
  int32_t* table = (int32_t*)tn;
  if (U > 0) {
    skt::slot_set_kernel<<<skt::grid_for(U, threads), threads, 0, st>>>(
        table, (const int32_t*)rows, (const int32_t*)cols,
        (const int32_t*)vals, T, U);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (cells == 0) return 0;
  uint8_t* has = (uint8_t*)shutdown;
  cudaError_t err = cudaMemsetAsync(has, 0, (size_t)cells, st);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    const dim3 grid((unsigned)((T + threads - 1) / threads),
                    (unsigned)(S < 65535 ? S : 65535));
    skt::has_scatter_kernel<<<grid, threads, 0, st>>>(table, has, S, N, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool aligned = ((uintptr_t)eligible | (uintptr_t)create |
                        (uintptr_t)shutdown) % 16 == 0;
  const int64_t words = aligned ? cells / 16 : 0;
  if (words > 0) {
    skt::diff_vec_kernel<<<skt::grid_for(words, threads), threads, 0, st>>>(
        (const uint4*)eligible, (uint4*)create, (uint4*)shutdown, words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (words * 16 < cells) {
    skt::diff_byte_kernel<<<skt::grid_for(cells - words * 16, threads),
                            threads, 0, st>>>(
        (const uint8_t*)eligible, (uint8_t*)create, has, words * 16, cells);
    err = cudaGetLastError();
  }
  return (int)err;
}
