// K12 match_index_commit: the leader-side commit rule, the quorum-th
// largest of the managers' match indices.
//
// Replaces: swarmkit_tpu/ops/raft_replay.py `match_index_commit` (:118):
// sorted_desc = -sort(-match_index); commit = sorted_desc[quorum - 1],
// with JAX's indexing of a traced index: a negative index wraps once
// (i + M), then the index is clamped into [0, M - 1]. So quorum 0 (and
// any quorum > M) gives the smallest value.
//
// Bound on this card: latency. It reads M int32 (M <= 64 in practice: one
// per manager) and writes one; the work is M^2 compares, nothing for the
// card, so one small launch is what it costs.
//
// Design: no sort. One block; thread a ranks value a among all M by
// (value descending, index ascending): rank = #{b: x_b > x_a} +
// #{b < a: x_b == x_a}. The ranks are 0..M-1, each once, so exactly one
// thread holds rank i and writes its value.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void match_index_kernel(const int32_t* __restrict__ mi,
                                   const int32_t* __restrict__ quorum,
                                   int32_t* out, int M) {
  long long i = (long long)*quorum - 1;
  if (i < 0) i += M;
  i = i < 0 ? 0 : (i > M - 1 ? M - 1 : i);
  for (int a = threadIdx.x; a < M; a += blockDim.x) {
    const int32_t v = mi[a];
    int rank = 0;
    for (int b = 0; b < M; ++b) {
      const int32_t w = mi[b];
      rank += (w > v) || (w == v && b < a);
    }
    if (rank == i) *out = v;
  }
}

}  // namespace skt

extern "C" int skt_match_index_commit(const void* mi, const void* quorum,
                                      void* out, int M, void* stream) {
  const int threads = M < 1024 ? ((M + 31) / 32) * 32 : 1024;
  skt::match_index_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mi, (const int32_t*)quorum, (int32_t*)out, M);
  return (int)cudaGetLastError();
}
