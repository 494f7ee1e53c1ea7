// K16 task_count_flat: the runnable-task count per (service, node), flat,
// the carry of the O(churn) incremental diff.
//
// Replaces: swarmkit_tpu/ops/reconcile.py `task_count_flat` (:99):
//   flat = s * N + clip(tn[s, t], 0, N - 1)
//   cnt  = zeros(S * N).at[flat].add(tn[s, t] >= 0)           int32[S * N]
// The reference's flat key is int32 and wraps silently from S * N = 2^31;
// the host refuses that size, so every offset here fits in 32 bits and is
// taken in 64 all the same.
//
// Bound on this card: memory. It must read 4 * S * T bytes and write
// 4 * S * N (at 200 x 50,000 nodes, T = 2,000: 41.6 MB, about 12 us at
// 3.35 TB/s); one atomic add per runnable task.
//
// Design: a memset of the output, then one thread per (s, t), a row of
// blocks per service, each adding 1 at its cell with atomicAdd where
// tn >= 0. The adds of a converged table spread over distinct cells, so
// the atomics rarely collide.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void task_count_kernel(const int32_t* __restrict__ tn,
                                  int32_t* cnt, int S, int T, int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int32_t v = tn[(int64_t)s * T + t];
    if (v >= 0) atomicAdd(cnt + (int64_t)s * N + (v < N ? v : N - 1), 1);
  }
}

}  // namespace skt

// cnt: int32[S * N], S * N >= 1
extern "C" int skt_task_count_flat(const void* tn, void* cnt, int S, int T,
                                   int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(cnt, 0, (size_t)S * N * sizeof(int32_t), st);
  if (err != cudaSuccess || T == 0) return (int)err;
  const int threads = 256;
  const dim3 grid((unsigned)((T + threads - 1) / threads),
                  (unsigned)(S < 65535 ? S : 65535));
  skt::task_count_kernel<<<grid, threads, 0, st>>>(
      (const int32_t*)tn, (int32_t*)cnt, S, T, N);
  return (int)cudaGetLastError();
}
