// K11 frontier_advance_burst: B rounds of the raft frontier advance on the
// resident ack matrix, in one launch.
//
// Replaces: swarmkit_tpu/ops/raft_replay.py `frontier_advance_burst` (:95),
// a lax.scan over frontiers_b int32[B, M] whose step ORs
// `arange(E) < frontier[m]` into row m of acks bool[M, E] and recomputes the
// commit index as `replay_commit` does (tally >= quorum, length of the
// True prefix); `frontier_advance` (:68) is the same with B = 1.
//
// Bound on this card: memory. It must read the M x E ack bytes once and
// write them once (10 MB at 5 x 1,000,000: about 3 us at 3.35 TB/s), plus
// B * M frontiers; the tally is M adds per entry and round.
//
// Design: the OR is monotone, so after round b row m holds
// acks0[m, e] | (e < F[b, m]) with F the running maximum of the frontiers
// over rounds <= b. No round needs the previous round's matrix: one thread
// per entry reads its column of acks0 and loops over the B rounds, keeping
// F in shared memory (updated by the block at the top of each round); the
// column's bytes come from device memory once and from the cache in later
// rounds. A round's commit index is the first entry whose tally is below
// quorum: a warp's first failing lane by ballot, the block's by a shared
// atomicMin, then one global atomicMin into commits[b] (which the wrapper
// fills with E), skipped when commits[b] already holds a smaller entry.
// After the last round each thread writes its column of acks' once.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void frontier_burst_kernel(const uint8_t* __restrict__ acks,
                                      const int32_t* __restrict__ fronts,
                                      const int32_t* __restrict__ quorum,
                                      int32_t* commits, uint8_t* out, int M,
                                      int E, int B) {
  extern __shared__ int32_t fcur[];  // [M] running maximum of the frontiers
  __shared__ int32_t bmin;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int e = blockIdx.x * nt + tid;
  const int32_t q = *quorum;
  for (int m = tid; m < M; m += nt) fcur[m] = INT_MIN;
  for (int b = 0; b < B; ++b) {
    __syncthreads();  // the previous round's readers are done
    for (int m = tid; m < M; m += nt) {
      const int32_t f = fronts[(int64_t)b * M + m];
      if (f > fcur[m]) fcur[m] = f;
    }
    if (tid == 0) bmin = INT_MAX;
    __syncthreads();
    bool fail = false;
    if (e < E) {
      int32_t tally = 0;
      for (int m = 0; m < M; ++m)
        tally += acks[(int64_t)m * E + e] | (e < fcur[m]);
      fail = tally < q;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, fail);
    if (bal && lane == 0) atomicMin(&bmin, e + __ffs(bal) - 1);
    __syncthreads();
    if (tid == 0 && bmin != INT_MAX &&
        bmin < *(volatile int32_t*)(commits + b))
      atomicMin(commits + b, bmin);
  }
  __syncthreads();
  if (e < E)
    for (int m = 0; m < M; ++m) {
      const int64_t i = (int64_t)m * E + e;
      out[i] = acks[i] | (e < fcur[m]);
    }
}

}  // namespace skt

extern "C" int skt_frontier_advance_burst(const void* acks, const void* fronts,
                                          const void* quorum, void* commits,
                                          void* out, int M, int E, int B,
                                          void* stream) {
  const int threads = 256;  // a multiple of 32: the ballot needs whole warps
  const unsigned blocks = (unsigned)((E + threads - 1) / threads);
  skt::frontier_burst_kernel<<<blocks, threads, M * sizeof(int32_t),
                               (cudaStream_t)stream>>>(
      (const uint8_t*)acks, (const int32_t*)fronts, (const int32_t*)quorum,
      (int32_t*)commits, (uint8_t*)out, M, E, B);
  return (int)cudaGetLastError();
}
