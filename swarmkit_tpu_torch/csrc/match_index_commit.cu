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
// card, so one small launch is what it costs, and the host's side of the
// call (allocation, ctypes, the launch) is most of that.
//
// Design: no sort, and each value read once from device memory. Value a's
// rank among all M, by (value descending, index ascending), is
//   rank(a) = #{b: x_b > x_a} + #{b < a: x_b == x_a};
// the ranks are 0..M-1, each once, so exactly one thread holds rank i and
// writes its value.
//   * M <= 32: one warp. Lane a keeps x_a in a register and meets every
//     other value through __shfl_sync.
//   * M > 32: one block of up to 1,024 threads. The values are staged in
//     shared memory once (kTile of them); a thread ranks values a, a +
//     blockDim, ... against the stage. Beyond kTile values the stage is
//     refilled tile by tile for each stride of the block (slower, right).
// Two entries: the quorum passed by value (no upload, nothing for the host
// to wait on), or read on the card from an int32 pointer (a quorum that is
// already a CUDA tensor is never read on the host). The kernel turns it
// into the sorted index.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int kTile = 8192;   // int32 values staged at a time: 32 KB

// JAX's traced-index rule on sorted_desc[quorum - 1]: wrap once, clamp
__device__ __forceinline__ int commit_slot(long long quorum, int M) {
  long long i = quorum - 1;
  if (i < 0) i += M;
  return (int)(i < 0 ? 0 : (i > M - 1 ? M - 1 : i));
}

// the quorum is *quorum when that pointer is set, else q
__global__ void match_index_warp(const int32_t* __restrict__ quorum, int q,
                                 const int32_t* __restrict__ mi,
                                 int32_t* out, int M) {
  const int a = threadIdx.x;
  const int i = commit_slot(quorum != nullptr ? *quorum : q, M);
  const int32_t v = a < M ? mi[a] : 0;
  int rank = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int32_t w = __shfl_sync(0xffffffffu, v, b);
    rank += (b < M) & ((w > v) | ((w == v) & (b < a)));
  }
  if (a < M && rank == i) *out = v;
}

__global__ void match_index_block(const int32_t* __restrict__ quorum, int q,
                                  const int32_t* __restrict__ mi,
                                  int32_t* out, int M) {
  __shared__ int32_t stage[kTile];
  const int i = commit_slot(quorum != nullptr ? *quorum : q, M);
  const bool whole = M <= kTile;
  if (whole) {
    for (int b = threadIdx.x; b < M; b += blockDim.x) stage[b] = mi[b];
    __syncthreads();
  }
  for (int base = 0; base < M; base += blockDim.x) {
    const int a = base + threadIdx.x;
    const int32_t v = a < M ? (whole ? stage[a] : mi[a]) : 0;
    int rank = 0;
    for (int t0 = 0; t0 < M; t0 += kTile) {
      const int n = M - t0 < kTile ? M - t0 : kTile;
      if (!whole) {
        __syncthreads();
        for (int b = threadIdx.x; b < n; b += blockDim.x)
          stage[b] = mi[t0 + b];
        __syncthreads();
      }
      for (int b = 0; b < n; ++b) {
        const int32_t w = stage[b];
        rank += (w > v) | ((w == v) & (t0 + b < a));
      }
    }
    if (a < M && rank == i) *out = v;
  }
}

int launch(const void* quorum, int q, const void* mi, void* out, int M,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 32) {
    match_index_warp<<<1, 32, 0, st>>>((const int32_t*)quorum, q,
                                       (const int32_t*)mi, (int32_t*)out, M);
  } else {
    const int threads = M < 1024 ? ((M + 31) / 32) * 32 : 1024;
    match_index_block<<<1, threads, 0, st>>>((const int32_t*)quorum, q,
                                             (const int32_t*)mi,
                                             (int32_t*)out, M);
  }
  return (int)cudaGetLastError();
}

}  // namespace skt

// The quorum on the card: an int32 pointer, read by the kernel.
extern "C" int skt_match_index_commit(const void* mi, const void* quorum,
                                      void* out, int M, void* stream) {
  return skt::launch(quorum, 0, mi, out, M, stream);
}

// The quorum on the host, by value.
extern "C" int skt_match_index_commit_at(const void* mi, int quorum,
                                         void* out, int M, void* stream) {
  return skt::launch(nullptr, quorum, mi, out, M, stream);
}
