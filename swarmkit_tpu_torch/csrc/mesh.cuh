// Shared device helpers of the sharded placement kernels (K20
// sharded_water_fill.cu, K21 sharded_binpack_fill.cu).
//
// A mesh on one card is k node shards, each its own set of tensors. One
// block stands for one shard's device: it reads and folds only its shard's
// node arrays, through its row of the per-shard pointer table. The blocks
// are launched cooperatively, so all k are co-resident and
// cooperative_groups' grid barrier joins them. A cross-shard sum (the
// reference's `lax.psum` over the node axis, which XLA inserts) is then:
// the shard's block reduction, a write of that partial into an exchange row
// of k slots, the grid barrier, and every block folding the k partials in
// shard order. Integer sums are exact in any order, so each result equals
// the one-device kernel's block reduction.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace skt {

namespace cg = cooperative_groups;

// One shard's node-axis arrays: a row of the pointer table (8 pointers, in
// this order; parallel/fill.py `_shard_rows`). n is the shard's node count.
struct ShardRow {
  const uint8_t* mask;         // [G, n] static eligibility
  const uint8_t* penalty;      // [G, n]
  const int32_t* spread_rank;  // [G, L, n] global branch ids (< N padded)
  int32_t* totals;             // [n]
  int32_t* svc_counts;         // [S, n]
  int32_t* avail;              // [n, R]
  uint8_t* port_used;          // [n, PV]
  int32_t* out;                // [G, n] counts
};

// The group-side tables, replicated: one copy on the card.
struct GroupSide {
  const int32_t* need_res;      // [G, R]
  const int32_t* n_tasks;       // [G]
  const int32_t* svc_idx;       // [G]
  const int32_t* max_replicas;  // [G]
  const uint8_t* has_ports;     // [G]
  const uint8_t* group_ports;   // [G, PV]
};

// The block's view of its shard in the one-device kernels' terms, so that
// node_cap and fold_node (common.cuh) apply unchanged with N = n.
__device__ __forceinline__ GroupArgs shard_group_args(const GroupSide& gs,
                                                      const ShardRow& r) {
  return GroupArgs{r.mask,      gs.need_res,  gs.n_tasks,    gs.svc_idx,
                   gs.max_replicas, r.penalty, gs.has_ports, gs.group_ports};
}

__device__ __forceinline__ NodeState shard_state(const ShardRow& r) {
  return NodeState{r.totals, r.svc_counts, r.avail, r.port_used};
}

// The exchange of the cross-shard reductions: two rows of k slots that
// alternate, so a row is written again only after every block has read it
// (the barrier of the call in between orders the two).
struct Exchange {
  long long* buf;  // [2, k]
  int parity;

  __device__ __forceinline__ long long* next_row() {
    long long* row = buf + parity * gridDim.x;
    parity ^= 1;
    return row;
  }
};

// The sum over all shards of every thread's v (lax.psum of the shards'
// block sums); every thread of every block gets it.
__device__ __forceinline__ long long grid_sum(long long v, long long* red,
                                              Exchange& x,
                                              cg::grid_group& grid) {
  const long long part = block_sum(v, red);
  long long* row = x.next_row();
  if (threadIdx.x == 0) row[blockIdx.x] = part;
  grid.sync();
  long long t = 0;
  for (int b = 0; b < (int)gridDim.x; ++b) t += row[b];
  return t;
}

// The maximum over all shards of every thread's v (lax.pmax).
__device__ __forceinline__ long long grid_max(long long v, long long* red,
                                              Exchange& x,
                                              cg::grid_group& grid) {
  const long long part = block_max(v, red);
  long long* row = x.next_row();
  if (threadIdx.x == 0) row[blockIdx.x] = part;
  grid.sync();
  long long t = row[0];
  for (int b = 1; b < (int)gridDim.x; ++b) t = row[b] > t ? row[b] : t;
  return t;
}

// The sum of the blocks' `total` over the shards before this one (the
// cross-shard exclusive scan of a per-block count).
__device__ __forceinline__ long long grid_excl_prefix(long long total,
                                                      Exchange& x,
                                                      cg::grid_group& grid) {
  long long* row = x.next_row();
  if (threadIdx.x == 0) row[blockIdx.x] = total;
  grid.sync();
  long long t = 0;
  for (int b = 0; b < (int)blockIdx.x; ++b) t += row[b];
  return t;
}

// Launch a sharded fill kernel on k cooperative blocks of FILL_THREADS, or
// return the CUDA error that refuses it: no cooperative launch on this
// device, or more blocks than the card holds co-resident
// (cudaErrorCooperativeLaunchTooLarge); never a launch that could hang.
inline int max_coresident(const void* kernel) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        FILL_THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  return sms * per_sm;
}

inline int launch_cooperative(const void* kernel, int k, void** args,
                              cudaStream_t stream) {
  const int most = max_coresident(kernel);
  if (most < 0) return -most;
  if (k < 1 || k > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(k), dim3(FILL_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace skt
