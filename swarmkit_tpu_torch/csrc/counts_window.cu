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
// Bound on this card: memory. It reads 4 bytes and writes 2 (or 4) per
// window cell.
//
// Design: a 2-D grid, a row of blocks per group (striding when there are
// more groups than grid rows); neighbouring threads read and write
// neighbouring cells of the row.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

template <typename T>
__global__ void counts_window_kernel(const int32_t* counts, T* out, int G,
                                     int N, int Np) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  for (int g = blockIdx.y; g < G; g += gridDim.y)
    out[(int64_t)g * N + n] = (T)counts[(int64_t)g * Np + n];
}

}  // namespace skt

extern "C" int skt_counts_window(const void* counts, void* out, int G, int N,
                                 int Np, int compact, void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((N + threads - 1) / threads),
                  (unsigned)(G < 65535 ? G : 65535));
  cudaStream_t st = (cudaStream_t)stream;
  if (compact)
    skt::counts_window_kernel<int16_t><<<grid, threads, 0, st>>>(
        (const int32_t*)counts, (int16_t*)out, G, N, Np);
  else
    skt::counts_window_kernel<int32_t><<<grid, threads, 0, st>>>(
        (const int32_t*)counts, (int32_t*)out, G, N, Np);
  return (int)cudaGetLastError();
}
