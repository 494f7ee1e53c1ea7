// K22 sharded_replay_tally: the raft quorum tally and commit index over an
// ack matrix split into k shards on one card, in either of the reference's
// two layouts.
//
// Replaces: swarmkit_tpu/ops/raft_replay.py `sharded_replay_commit`'s
// kernel (:49-55: the per-device tally, `lax.psum` over the managers axis,
// the quorum test, the True-prefix) and the commit of
// swarmkit_tpu/parallel/mesh.py's fused step (`sharded_cluster_step` :224,
// acks split on the log axis :238-247, the prefix crossing shards).
//
//   managers split (layout 0): shard b holds M/k manager rows of all E
//     entries; tally[e] = the sum over shards, in shard order, of the
//     shards' partial tallies; commit = the first e with tally < quorum
//     (E when none); committed[e] = e < commit.
//   log split (layout 1): shard b holds all M rows of entries
//     [b * Eb, (b + 1) * Eb); the tally is elementwise, so each shard finds
//     its first local hole; commit = the least of b * Eb + hole_b over the
//     shards that have one (k * Eb when none); shard b's committed[e] =
//     b * Eb + e < commit.
//
// Bound on this card: memory. It must read the M x E ack bytes once and
// write E committed bytes (the partial tallies are 4 k bytes an entry of
// scratch on top).
//
// Design: three launches instead of a grid barrier. (1) One thread per
// (entry, shard) sums its shard's column into a [k, Eb] partial. (2) Managers:
// one thread per entry folds the k partials in shard order and lowers the
// commit with atomicMin; log: one thread per (entry, shard) lowers its
// shard's hole with atomicMin. (3) Every thread folds the k holes (log) or
// reads the commit (managers) and writes its committed flag. The shards are
// reached through a device table of k input pointers (and, for the log
// split, k output pointers), uploaded once per call.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int TALLY_THREADS = 256;

__global__ void partial_tally_kernel(const uint64_t* in, int32_t* partial,
                                     int Mb, int Eb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= Eb) return;
  const uint8_t* acks = (const uint8_t*)in[b];
  int32_t t = 0;
  for (int m = 0; m < Mb; ++m) t += acks[(int64_t)m * Eb + e];
  partial[(int64_t)b * Eb + e] = t;
}

__global__ void vote_managers_kernel(const int32_t* partial,
                                     const int32_t* quorum, int32_t* commit,
                                     int k, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int32_t tally = 0;
  for (int b = 0; b < k; ++b) tally += partial[(int64_t)b * E + e];
  if (tally < *quorum) atomicMin(commit, e);
}

__global__ void vote_log_kernel(const int32_t* partial, const int32_t* quorum,
                                int32_t* hole, int Eb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= Eb) return;
  if (partial[(int64_t)b * Eb + e] < *quorum) atomicMin(&hole[b], e);
}

__global__ void prefix_managers_kernel(const int32_t* commit,
                                       uint8_t* committed, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E) committed[e] = e < *commit;
}

__global__ void prefix_log_kernel(const int32_t* hole, int32_t* commit,
                                  const uint64_t* out, int k, int Eb) {
  int32_t c = k * Eb;  // no hole in any shard
  for (int s = 0; s < k; ++s)
    if (hole[s] < Eb && s * Eb + hole[s] < c) c = s * Eb + hole[s];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e == 0 && b == 0) *commit = c;
  if (e < Eb) ((uint8_t*)out[b])[e] = b * Eb + e < c;
}

}  // namespace skt

// layout 0: managers split, `commit` starts at E (= Eb) and `committed` is
// one bool[E]; layout 1: log split, `hole` holds k values of Eb and `table`
// has k output pointers after the k inputs. Mb, Eb: one shard's shape.
extern "C" int skt_sharded_replay_tally(const void* table, const void* quorum,
                                        void* partial, void* hole,
                                        void* commit, void* committed,
                                        int layout, int k, int Mb, int Eb,
                                        void* stream) {
  const int threads = skt::TALLY_THREADS;
  const dim3 grid((unsigned)((Eb + threads - 1) / threads), (unsigned)k);
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t* tab = (const uint64_t*)table;
  const int32_t* q = (const int32_t*)quorum;
  int32_t* part = (int32_t*)partial;
  skt::partial_tally_kernel<<<grid, threads, 0, st>>>(tab, part, Mb, Eb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (layout == 0) {
    const dim3 flat(grid.x);
    skt::vote_managers_kernel<<<flat, threads, 0, st>>>(part, q,
                                                        (int32_t*)commit, k,
                                                        Eb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    skt::prefix_managers_kernel<<<flat, threads, 0, st>>>(
        (const int32_t*)commit, (uint8_t*)committed, Eb);
    return (int)cudaGetLastError();
  }
  skt::vote_log_kernel<<<grid, threads, 0, st>>>(part, q, (int32_t*)hole, Eb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skt::prefix_log_kernel<<<grid, threads, 0, st>>>(
      (const int32_t*)hole, (int32_t*)commit, tab + k, k, Eb);
  return (int)cudaGetLastError();
}
