// K18 replica_slot_state: the replicated orchestrator's slot census, one
// pass over the live task rows of S services with slots in [0, M).
//
// Replaces: swarmkit_tpu/ops/reconcile.py `replica_slot_state` (:202):
//   key            = service_idx * M + slot                   int32[T]
//   used           = zeros(S * M).at[key].max(True)            bool[S * M]
//   slot_runnable  = zeros(S * M).at[key].max(runnable)        bool[S * M]
//   slot_running   = zeros(S * M).at[key].max(running)         bool[S * M]
//   runnable_slots = slot_runnable.reshape(S, M).sum(1)        int32[S]
// The reference's flat key is int32 and wraps silently from S * M = 2^31;
// the host refuses that size and any index outside [0, S) x [0, M), so
// every key here lies in the planes. It is taken in 64 bits all the same.
//
// Bound on this card: memory. It must read 10 bytes a task (two int32
// indices, two bool flags) and write 3 * S * M + 4 * S bytes (at the
// chip smoke's census, T = 208,000 and S x M = 100,000 x 11: 5.8 MB, about
// 1.7 us at 3.35 TB/s).
//
// Design: three memsets zero the planes; kernel 1 has one thread a task
// and stores the byte 1 into each plane its flags select. Two tasks of one
// slot race to store the same value, which needs no atomics. Kernel 2
// gives one warp to each service row: its lanes sum the row's M bytes of
// slot_runnable (strided by 32) and a shuffle reduction leaves the count
// in lane 0. The row sum is not fused into kernel 1: it would need a
// compare-and-swap on a 32-bit word per cell to count each slot once, and
// the planes are bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void slot_census_scatter(const int32_t* __restrict__ sidx,
                                    const int32_t* __restrict__ slot,
                                    const uint8_t* __restrict__ runnable,
                                    const uint8_t* __restrict__ running,
                                    uint8_t* used, uint8_t* slot_runnable,
                                    uint8_t* slot_running, int T, int M) {
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T; t += stride) {
    const int64_t key = (int64_t)sidx[t] * M + slot[t];
    used[key] = 1;
    if (runnable[t]) slot_runnable[key] = 1;
    if (running[t]) slot_running[key] = 1;
  }
}

__global__ void slot_census_rows(const uint8_t* __restrict__ slot_runnable,
                                 int32_t* __restrict__ rows, int S, int M) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // every lane of a warp takes the same rows, so the shuffles see them all
  for (int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < S;
       s += warps) {
    const uint8_t* row = slot_runnable + (int64_t)s * M;
    int32_t c = 0;
    for (int j = lane; j < M; j += 32) c += row[j];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) rows[s] = c;
  }
}

}  // namespace skt

// used, slot_runnable, slot_running: uint8[S * M]; rows: int32[S].
// sidx in [0, S) and slot in [0, M) for every task; S * M < 2^31.
extern "C" int skt_replica_slot_state(const void* sidx, const void* slot,
                                      const void* runnable,
                                      const void* running, void* used,
                                      void* slot_runnable, void* slot_running,
                                      void* rows, int T, int S, int M,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)S * M;
  void* planes[3] = {used, slot_runnable, slot_running};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = cudaMemsetAsync(planes[i], 0, cells, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  if (T > 0) {
    const int blocks = (T + threads - 1) / threads;
    skt::slot_census_scatter<<<blocks < 65535 * 8 ? blocks : 65535 * 8,
                               threads, 0, st>>>(
        (const int32_t*)sidx, (const int32_t*)slot, (const uint8_t*)runnable,
        (const uint8_t*)running, (uint8_t*)used, (uint8_t*)slot_runnable,
        (uint8_t*)slot_running, T, M);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (S > 0) {
    const long long want = ((long long)S * 32 + threads - 1) / threads;
    const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
    skt::slot_census_rows<<<blocks, threads, 0, st>>>(
        (const uint8_t*)slot_runnable, (int32_t*)rows, S, M);
  }
  return (int)cudaGetLastError();
}
