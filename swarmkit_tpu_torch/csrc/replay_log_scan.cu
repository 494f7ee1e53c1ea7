// K13 replay_log_scan: the streaming form of the raft replay.
//
// Replaces: swarmkit_tpu/ops/raft_replay.py `replay_log_scan` (:126), a
// lax.scan over [chunk]-column slices of acks bool[M, E] (plus the E % chunk
// tail) that tallies each slice, carries a "prefix still unbroken" flag and
// sums the committed prefix; its result equals `replay_commit`'s commit
// index with peak scratch O(M x chunk).
//
// Bound on this card: memory. It reads the M x E ack bytes up to the end of
// the chunk that holds the commit index (the scan stops there) and writes
// one int32 (5 MB at 5 x 1,000,000 when nothing fails: about 1.5 us at
// 3.35 TB/s); M adds per entry.
//
// Design: no [E] tally and no committed mask; scratch is the one int32 the
// wrapper fills with E. The grid covers one chunk (thread j owns column j of
// every chunk) and walks the chunks in order, as the reference's scan does.
// An entry below quorum lowers the commit index by atomicMin (a warp's first
// failing lane by ballot, one atomic per warp), as K4 does. Before each
// chunk, a warp reads the commit index and stops once it lies before the
// chunk: the reference's `alive` carry, which a block may read late (it then
// scans on; the minimum stays right).
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void replay_log_scan_kernel(const uint8_t* __restrict__ acks,
                                       const int32_t* __restrict__ quorum,
                                       int32_t* commit, int M, int E,
                                       int chunk) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t q = *quorum;
  for (long long c0 = 0; c0 < E; c0 += chunk) {
    int32_t cur = 0;
    if (lane == 0) cur = *(volatile int32_t*)commit;
    cur = __shfl_sync(0xffffffffu, cur, 0);
    if (cur <= c0) break;  // warp-uniform: the prefix broke earlier
    const long long e = c0 + j;
    bool fail = false;
    if (j < chunk && e < E) {
      int32_t tally = 0;
      for (int m = 0; m < M; ++m) tally += acks[(int64_t)m * E + e];
      fail = tally < q;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, fail);
    if (bal && lane == 0)
      atomicMin(commit, (int32_t)(e + __ffs(bal) - 1));
  }
}

}  // namespace skt

extern "C" int skt_replay_log_scan(const void* acks, const void* quorum,
                                   void* commit, int M, int E, int chunk,
                                   void* stream) {
  const int threads = 256;  // a multiple of 32: the ballot needs whole warps
  const int cols = chunk < E ? chunk : E;
  const unsigned blocks = (unsigned)((cols + threads - 1) / threads);
  skt::replay_log_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)acks, (const int32_t*)quorum, (int32_t*)commit, M, E,
      chunk);
  return (int)cudaGetLastError();
}
